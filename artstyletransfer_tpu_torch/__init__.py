"""artstyletransfer_tpu_torch — the PyTorch/CUDA port of ``artstyletransfer_tpu``.

Improved Gatys style transfer (multi-resolution pyramid loss, structured
style-derived noise initialization, Adam or strong-Wolfe L-BFGS) running
on an NVIDIA H100 through PyTorch, with hand-written CUDA kernels for the
Gram matrix, its backward, the total-variation sums and the fused 3x3
conv + bias + ReLU (kernels/), a batched job queue (parallel/) placed over
several cards by a jobs mesh (parallel/mesh.py), and live serving with
chunk-boundary joins (parallel/live.py, runtime/online.py).

The JAX package ``artstyletransfer_tpu`` is the reference this package is
tested against; this package never imports it, nor JAX. Entry points
(TransferJob, neural_style_transfer, Executor, BatchedTransferJob,
run_job_queue, LiveBatchRunner, OnlineBatchingExecutor, the CLIs) run on
CUDA unless the caller passes device='cpu'.
"""

__version__ = "0.1.0"

from .config import Config, simultaneous_tasks_count  # noqa: F401


_LAZY = {
    "ContentStylePair": "engine.transfer",
    "TransferJob": "engine.transfer",
    "neural_style_transfer": "engine.transfer",
    "Executor": "runtime.executor",
    "OnlineBatchingExecutor": "runtime.online",
    "prepare_model": "models.vgg19",
    "extract_features": "models.vgg19",
    "load_vgg19_params": "models.weights",
    "gram_matrix": "ops.gram",
    "total_variation": "ops.tv",
    "prepare_img": "utils.image",
    "unprepare_img": "utils.image",
    "load_image": "utils.image",
    "run_job_queue": "parallel.batch",
    "BatchedTransferJob": "parallel.batch",
    "LiveBatchRunner": "parallel.live",
    "jobs_mesh": "parallel.mesh",
    "jobs_space_mesh": "parallel.mesh",
    "multislice_jobs_space_mesh": "parallel.mesh",
    "default_serving_mesh": "parallel.mesh",
}


def __getattr__(name):
    """Lazy top-level exports, the JAX package's names (keeps `import
    artstyletransfer_tpu_torch` light)."""
    if name in _LAZY:
        import importlib

        module = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
