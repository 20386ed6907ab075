from .models import (
    V2_SCALE_SPECS,
    V3_SCALE_SPECS,
    DiscriminatorP,
    DiscriminatorS,
    Generator,
    HifiganConfig,
    HifiganDiscriminator,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    ResBlock1,
    ResBlock2,
    SpectralNormConv1d,
)

__all__ = ["DiscriminatorP", "DiscriminatorS", "Generator", "HifiganConfig",
           "HifiganDiscriminator", "MultiPeriodDiscriminator", "MultiScaleDiscriminator",
           "ResBlock1", "ResBlock2", "SpectralNormConv1d", "V2_SCALE_SPECS", "V3_SCALE_SPECS"]
