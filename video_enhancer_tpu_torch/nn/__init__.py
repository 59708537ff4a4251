"""Layers on parameter dictionaries (counterpart of video_enhancer_tpu.nn)."""

from .core import (clip, conv2d_apply, conv2d_init, conv3d_apply, conv3d_init,
                   conv_transpose2d_apply, dense_apply, dense_init,
                   group_norm_apply, group_norm_init, layer_norm_apply,
                   layer_norm_init, mlp_apply, mlp_init, rms_norm_apply,
                   rms_norm_init, sinusoidal_embedding)

__all__ = ["clip", "conv2d_apply", "conv2d_init", "conv3d_apply", "conv3d_init",
           "conv_transpose2d_apply",
           "dense_apply", "dense_init", "group_norm_apply", "group_norm_init",
           "layer_norm_apply", "layer_norm_init", "mlp_apply", "mlp_init",
           "rms_norm_apply", "rms_norm_init", "sinusoidal_embedding"]
