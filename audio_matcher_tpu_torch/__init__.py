"""PyTorch/CUDA port of ``audio_matcher_tpu``'s batch scan.

The package mirrors the JAX package's module names. It imports ``torch``
and numpy only, never ``jax``. Every kernel wrapper runs its plain PyTorch
version on a CPU tensor and its hand-written CUDA kernel (``csrc/``) on a
CUDA tensor, or raises. The entry point is
:class:`audio_matcher_tpu_torch.parallel.sweep.ShardedScanner`.
"""
