"""Data of the PyTorch port: the patch pipeline, the bundled lines data and
synthetic volumes."""
from .bundled import dataset_path, lines_dataset, lines_wavelet
from .patcher import (PatchExtractor, cosinetaper, count_patches, flat_index_map,
                      hanningtaper, in_content_cropped_shape,
                      mid_intensity_high_texture, overlap_add, patch_array_shape,
                      taper2d, taper3d)
from .pipeline import (extract_patches, get_patch_extractor,
                       reconstruct_patches, transpose_patches_25d)
from .synthetic import (decimated_pair, flagship_problem, hyperbolic_events,
                        random_trace_mask, source_wavelet,
                        synth_hyperbolic)

__all__ = ["PatchExtractor", "cosinetaper", "count_patches", "dataset_path",
           "decimated_pair", "extract_patches", "flagship_problem", "flat_index_map",
           "get_patch_extractor", "hanningtaper", "hyperbolic_events",
           "in_content_cropped_shape", "lines_dataset", "lines_wavelet",
           "mid_intensity_high_texture", "overlap_add", "patch_array_shape",
           "random_trace_mask", "reconstruct_patches", "source_wavelet", "synth_hyperbolic",
           "taper2d", "taper3d", "transpose_patches_25d"]
