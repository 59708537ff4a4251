"""The eval side of the JAX package's train/: the synthetic degradation
data (``data``, ``evalgen``), the multi-seed quality evaluation of the
bundled weights and the qualification report (``evalsuite``) and the
calibrated perceptual metric (``lpips``). The data is made on the host in
numpy (``ops/cvhost.py`` and ``io/jpeg.py`` in place of OpenCV); the
models run on the card unless the caller asks for the CPU. Training itself
(losses, the train step, the proxy's trainer, the training data's chain
family) is not ported.
"""
