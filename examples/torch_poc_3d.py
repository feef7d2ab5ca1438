"""Proof-of-concept 3D run through the PyTorch port: the configuration of
``examples/poc_3d.py`` (the reference ``proof_of_concept_3D.ipynb``, cell
4: a (256, 128, 128, 1) patch, MulResUnet 3D, inputdepth 64, gain 40,
trilinear upsampling, L1, 3000 epochs; bfloat16 and phase space at 3
levels) through the port's ``cli.run`` and ``io.show_results``, on the CUDA
card with both kernel switches on (the fused loss and ``DPI_PALLAS_WGRAD=1``;
the trilinear upsample's backward is the port's own kernel). The volume is
the JAX repository's synthetic benchmark volume (``synth_hyperbolic``, the
reference's hyperbolic3d is not in its tree) with 66 % of the traces dropped.

Usage: python examples/torch_poc_3d.py [epochs] [nt nx ny]
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    os.environ.setdefault("DPI_PALLAS_WGRAD", "1")
    import deep_prior_interpolation_tpu_torch as dpi
    from deep_prior_interpolation_tpu_torch.cli import run
    from deep_prior_interpolation_tpu_torch.data import synth_hyperbolic
    from deep_prior_interpolation_tpu_torch.io import show_results

    epochs = int(sys.argv[1]) if len(sys.argv) > 1 else 3000
    nt, nx, ny = (int(v) for v in sys.argv[2:5]) if len(sys.argv) > 4 else (256, 128, 128)
    vol = synth_hyperbolic(nt, nx, ny)
    rng = np.random.RandomState(1)
    mask = np.repeat((rng.rand(1, nx, ny) > 0.66).astype(np.float32), nt, 0)
    cfg = dpi.Config(
        imgdir=".", outdir="torch_poc_3d", datadim="3d", gain=40.0, epochs=epochs,
        loss="mae", lr=1e-3, inputdepth=64, upsample="linear",
        reg_noise_std=0.03, noise_std=0.1, savemodel=True,
        dtype="bfloat16", remat=False, phase_space=True, phase_levels=3,
        scan_chunk=25, fused_loss=True)
    outpath = run(cfg, results_root="./results", original=vol, corrupted=mask)
    _, summary = show_results(outpath, curves=1, savefig=True, original=vol)
    print(f"\nfinal SNR {summary['snr']:.2f} dB, PCORR {summary['pcorr'] * 100:.2f}% "
          f"after {epochs} epochs (reference notebook: +16.69 dB / 98.93% in 1h52m on "
          f"a V100, on other data)")


if __name__ == "__main__":
    main()
