from .bias_act import fma, get_activation, lrelu_agc
from .conv_resample import conv2d_resample
from .dense import dense_apply
from .modulated_conv import modulated_conv2d
from .noise import random_noise
from .upfirdn2d import (setup_filter, upfirdn2d, filter2d, upsample2d,
                        downsample2d)
