"""Layers on parameter dictionaries (counterpart of video_enhancer_tpu.nn)."""

from .core import (conv3d_apply, conv3d_init, dense_apply, dense_init,
                   layer_norm_apply, layer_norm_init, mlp_apply, mlp_init)

__all__ = ["conv3d_apply", "conv3d_init", "dense_apply", "dense_init",
           "layer_norm_apply", "layer_norm_init", "mlp_apply", "mlp_init"]
