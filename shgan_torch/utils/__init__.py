from .misc import assert_shape, constant_cache
from .timing import device_timeit
