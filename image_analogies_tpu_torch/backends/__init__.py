"""Matching backends of the port (the JAX package's ``backends/`` seam):
``CudaMatcher`` on ``params.device`` for ``backend="cuda"``, the host
oracle ``CpuMatcher`` for ``backend="cpu"``."""

from image_analogies_tpu_torch.backends.base import LevelJob, Matcher


def get_backend(params, device=None) -> "Matcher":
    """The matcher ``params.backend`` names; ``device`` (default
    ``params.device``) places the CUDA matcher and raises where it names
    a card that is not there."""
    if params.backend == "cpu":
        from image_analogies_tpu_torch.backends.cpu import CpuMatcher

        return CpuMatcher(params)
    if params.backend == "cuda":
        from image_analogies_tpu_torch.backends.cuda import CudaMatcher
        from image_analogies_tpu_torch.models.analogy import resolve_device

        return CudaMatcher(params, resolve_device(
            params.device if device is None else device))
    raise ValueError(f"unknown backend {params.backend!r}")


__all__ = ["LevelJob", "Matcher", "get_backend"]
