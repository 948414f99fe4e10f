from .discriminator import DiscrimBlock, DiscrimEpilogue, Discriminator
from .encoder import Encoder, EncoderBlock, EncoderEpilogue
from .generator import CoModGANGenerator
from .infer import composite_forward, z_for_positions
from .layers import Conv2d, Conv2dLayer, Dense, SynthesisLayer, ToRGBLayer
from .mapping import Mapping
from .registry import get_model
from .shgan_encoder import ShganEncoder
from .shu import SHU
from .synthesis import CoModSynthesis, CoModSynthesisBlock, CoModSynthesisBlockFirst
