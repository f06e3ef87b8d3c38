"""MAML++ in PyTorch for an NVIDIA H100: the CUDA port of
``howtotrainyourmamlpytorch_tpu``.

The JAX package beside this one is the reference. This package keeps its
module paths and names, so a reader can find one from the other, and its
public layouts: images NHWC ``[S, H, W, C]``, labels ``[S]``, probabilities
``[Q, n_way]``, checkpoints in the JAX package's file format and layout.
Inside, the modules are plain PyTorch functions on tensor dicts; the two
TPU kernels (the fused LSLR update and its backward, ``ops/fused_update.py``)
are CUDA C++ kernels for ``sm_90a`` under ``csrc/``, built at first use.

It covers meta-training (``core.maml.MAMLSystem.train_step`` /
``eval_step``: second order, MSL, the outer Adam), the experiment layer
around it (:class:`ExperimentRunner`: the image-folder episode loader, the
epoch loop with validation, the run directory's files, checkpoints, resume
and best-model testing; the CLI ``python -m
howtotrainyourmamlpytorch_tpu_torch.train``) and serving
(``serving.engine.AdaptationEngine``: first-order adapt, then predict) with
the VGG backbone. It imports neither ``jax`` nor the JAX package. Entry
points run on ``device="cuda"`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .experiment import ExperimentRunner  # noqa: E402,F401
