from .discriminator import DiscrimBlock, DiscrimEpilogue, Discriminator
from .encoder import Encoder, EncoderBlock, EncoderEpilogue
from .generator import CoModGANGenerator, StyleGANGenerator
from .infer import composite_forward, z_for_positions
from .layers import (Conv2d, Conv2dLayer, Dense, SynthesisLayer, ToRGBLayer,
                     normalize_2nd_moment)
from .mapping import Mapping
from .registry import MODEL_REGISTRY, get_model, register
from .shgan_encoder import ShganEncoder
from .shu import SHU
from .synthesis import (CoModSynthesis, CoModSynthesisBlock,
                        CoModSynthesisBlockFirst, CoModSynthesisPlur,
                        StyleGANSynthesis, StyleGANSynthesisBlock)
