"""Training and its eval side: the losses (``losses``), the train step with
optax's global-norm clip and AdamW on a mesh (``step``), checkpoints with
``torch.save`` and the npz export for inference (``checkpoint``); the
synthetic degradation data (``data``, ``evalgen``), the multi-seed quality
evaluation of the bundled weights and the qualification report
(``evalsuite``) and the calibrated perceptual metric (``lpips``). The data
is made on the host in numpy (``ops/cvhost.py`` and ``io/jpeg.py`` in
place of OpenCV); the models run on the card unless the caller asks for
the CPU. The train CLI and the training data's chain family (a WebP round
trip) are not ported yet.
"""

from .losses import charbonnier_loss, vsr_loss  # noqa: F401
from .step import TrainState, make_train_step  # noqa: F401
