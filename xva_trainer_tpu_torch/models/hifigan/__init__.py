from .models import (
    V2_SCALE_SPECS,
    V3_SCALE_SPECS,
    DiscriminatorP,
    DiscriminatorS,
    Generator,
    HifiganConfig,
    ResBlock1,
    ResBlock2,
)

__all__ = ["DiscriminatorP", "DiscriminatorS", "Generator", "HifiganConfig", "ResBlock1",
           "ResBlock2", "V2_SCALE_SPECS", "V3_SCALE_SPECS"]
