from .discriminator import VitsDiscriminator
from .model import XVAPitch, XVAPitchConfig

__all__ = ["VitsDiscriminator", "XVAPitch", "XVAPitchConfig"]
