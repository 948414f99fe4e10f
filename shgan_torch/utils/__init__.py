from .misc import assert_shape, constant_cache, profiled_function
from .timing import device_timeit
