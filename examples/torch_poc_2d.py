"""Proof-of-concept 2D run through the PyTorch port: the configuration of
``examples/poc_2d.py`` (the reference ``proof_of_concept_2D.ipynb``, cell
4: the lines 170x100 gather, 66 % of the traces dropped, MulResUnet 2D,
inputdepth 64, L1, Adam 1e-3, gain 1, 3000 epochs) through the port's
``cli.run`` and ``io.show_results``, on the CUDA card with both kernel
switches on (the fused loss; ``DPI_PALLAS_WGRAD=1`` reaches 3D convs only).

Usage: python examples/torch_poc_2d.py [epochs]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    os.environ.setdefault("DPI_PALLAS_WGRAD", "1")
    import deep_prior_interpolation_tpu_torch as dpi
    from deep_prior_interpolation_tpu_torch.cli import run
    from deep_prior_interpolation_tpu_torch.data import lines_dataset
    from deep_prior_interpolation_tpu_torch.io import show_results

    epochs = int(sys.argv[1]) if len(sys.argv) > 1 else 3000
    img, mask = lines_dataset()
    cfg = dpi.Config(
        imgdir=".", imgname="original.npy", maskname="random66.npy",
        outdir="torch_poc_2d", datadim="2d", gain=1.0, epochs=epochs, loss="mae",
        lr=1e-3, inputdepth=64, upsample="nearest", reg_noise_std=0.03,
        noise_std=0.1, savemodel=True, fused_loss=True)
    outpath = run(cfg, results_root="./results", original=img, corrupted=mask)
    _, summary = show_results(outpath, curves=1, savefig=True, original=img)
    print(f"\nfinal SNR {summary['snr']:.2f} dB, PCORR {summary['pcorr'] * 100:.2f}% "
          f"after {epochs} epochs (reference notebook at 3000 epochs: -0.59 dB / 61.46%)")


if __name__ == "__main__":
    main()
