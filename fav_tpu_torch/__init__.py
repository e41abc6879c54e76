"""fav_tpu_torch — the PyTorch/CUDA port of fav_tpu for one NVIDIA H100.

The JAX package ``fav_tpu`` stays the reference; this package imports
nothing of it, nor JAX. Every Pallas kernel on a ported path becomes a CUDA
C++ kernel for ``sm_90a`` (``ops/csrc``), built with plain ``nvcc`` at first
use and bound with ``ctypes``; its plain PyTorch version sits beside it and
serves CPU tensors.

Layout:
    fav_tpu_torch.config     the config tree (own copy of fav_tpu.config's)
    fav_tpu_torch.device     resolve_device: cuda by default, cpu on request
    fav_tpu_torch.ops        Philox draws, corruption transforms, the signal
                             analyzer, AugMix, CUDA kernels
    fav_tpu_torch.models     FailureAwareCNN, confidence / uncertainty / anomaly
                             scalars, conformal set sizes, training (CE and
                             AugMix + JS, the megastep, pretrain CLI)
    fav_tpu_torch.data       CIFAR-10 or its deterministic synthetic stand-in
    fav_tpu_torch.utils      flax <-> torch weights and optax -> torch AdamW state;
                             latency histograms and stage timers
    fav_tpu_torch.pipeline   the detection megastep (corrupt -> CNN -> scalars)
    fav_tpu_torch.core       the host trust engine, attribution, session log;
                             the batched trust scan and the policy replay
    fav_tpu_torch.serving    the decision-support app (python -m
                             fav_tpu_torch.serving.app), its HTTP/WebSocket
                             runtime, the analysis and inference services
    fav_tpu_torch.sim        simulation mode's simulators, scripted streams
    fav_tpu_torch.io         video capture and the JPEG stream
    fav_tpu_torch.native     the C++ resize and JPEG codec, built by g++
"""

__version__ = "0.1.0"
