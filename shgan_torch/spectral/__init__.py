from .cweight import make_cweight, grid_sample_2d
from .dft import irfft2, rfft2
from .gaussian import gaussian_heatmap_2d, build_gaussian_split_maps
from .shu_ops import heterogeneous_filter_apply, spectral_shift, spectral_unshift
