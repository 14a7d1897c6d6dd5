"""Field networks as nn.Modules with the reference checkpoint's names."""

from .neuconw import (NeuconWField, field_background, field_forward, field_rgb, field_sdf,
                      init_field, inv_s)

__all__ = ["NeuconWField", "field_background", "field_forward", "field_rgb", "field_sdf",
           "init_field", "inv_s"]
