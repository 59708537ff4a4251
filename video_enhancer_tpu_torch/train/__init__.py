"""Training and its eval side: the losses (``losses``), the train step with
optax's global-norm clip and AdamW on a mesh (``step``), checkpoints with
``torch.save`` and the npz export for inference (``checkpoint``); the
synthetic degradation data (``data``, with its WebP chain family, and
``evalgen``), the train CLI (``cli``: ``python -m video_enhancer_tpu_torch.
train.cli``), the multi-seed quality evaluation of the bundled weights and
the qualification report (``evalsuite``), the calibrated perceptual metric
and its trainer (``lpips``), and the face restorer's and face detector's
trainers (``faces``, ``face_detector``). The data is made on the host in
numpy (``ops/cvhost.py``, ``io/jpeg.py`` and ``io/webp.py`` in place of
OpenCV); the models run on the card unless the caller asks for the CPU.
"""

from .losses import charbonnier_loss, vsr_loss  # noqa: F401
from .step import TrainState, make_train_step  # noqa: F401
