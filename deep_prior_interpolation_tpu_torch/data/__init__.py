"""Data of the PyTorch port: the patch pipeline, the bundled lines data and
synthetic volumes."""
from .bundled import dataset_path, lines_dataset, lines_wavelet
from .patcher import (PatchExtractor, count_patches, flat_index_map,
                      overlap_add, patch_array_shape, taper2d, taper3d)
from .pipeline import (extract_patches, get_patch_extractor,
                       reconstruct_patches, transpose_patches_25d)
from .synthetic import flagship_problem, hyperbolic_events, random_trace_mask

__all__ = ["PatchExtractor", "count_patches", "dataset_path", "extract_patches",
           "flagship_problem", "flat_index_map", "get_patch_extractor",
           "hyperbolic_events", "lines_dataset", "lines_wavelet", "overlap_add",
           "patch_array_shape", "random_trace_mask", "reconstruct_patches",
           "taper2d", "taper3d", "transpose_patches_25d"]
