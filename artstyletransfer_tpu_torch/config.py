"""Configuration for the PyTorch/CUDA style-transfer engine.

Same fields, defaults, presets and helpers as the JAX package's
``artstyletransfer_tpu/config.py`` (kept as an independent copy: this
package never imports the JAX one). Fields that only steer an XLA lowering
(``pool_impl``, ``use_pallas``) are kept so a config round-trips between
the two packages; the port reads what its engine implements and says so
where it differs.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Deque, Dict, Tuple

import torch

# Max style-transfer jobs optimizing concurrently (reference config.py:1).
simultaneous_tasks_count = 2


@dataclasses.dataclass(frozen=True)
class Config:
    """All engine settings. Defaults match reference config.py:5-18."""

    # --- loss weights ---
    content_weight: float = 1e3
    style_weight: float = 4e5
    tv_weight: float = 1e2

    # --- algorithm selection ---
    optimizer: str = "lbfgs"            # 'lbfgs' | 'adam'
    model: str = "vgg19"                # 'vgg19'
    init_method: str = "content+noise"  # 'random' | 'content+noise' | 'style'
    use_relu: bool = True               # post-ReLU taps; False = pre-ReLU
                                        # conv taps (conv4_2 is pre-ReLU
                                        # either way)

    # --- pyramid / iteration counts ---
    levels_num: int = 2
    iters_num: int = 500

    # --- structured noise init ---
    noise_factor: float = 0.95
    noise_levels: Tuple[int, ...] = (9, 18, 36, -1, 0)
    noise_levels_central_amplitude: Tuple[float, ...] = (0.30, 0.20, 0.10, 0.20, 0.20)
    noise_levels_peripheral_amplitude: Tuple[float, ...] = (0.20, 0.30, 0.40, 0.10, 0.00)
    noise_levels_dispersion: Tuple[float, ...] = (0.20, 0.30, 0.40, 0.60, 0.30)

    # --- optimizer hyperparameters ---
    lr_start: float = 10.0
    lr_decay: float = 0.999
    lr_decay_per_eval: bool = True      # decay lr on every loss evaluation
                                        # (the reference's closure semantics)
    lbfgs_history: int = 100            # torch's history_size default
    lbfgs_max_ls_steps: int = 25        # strong-Wolfe budget per step; 0 =
                                        # the reference's exact max_ls=0
    lbfgs_direction: str = "matrix"     # 'matrix' | 'loop' two-loop form
    lbfgs_t_init: str = "lr"            # first line-search trial: 'lr' |
                                        # 'unit'
    lbfgs_grams: str = "recompute"      # 'recompute' | 'incremental'
                                        # (S Yᵀ / Y Yᵀ carried in the state)
    lbfgs_state_dtype: str = "float32"  # 'float32' | 'bfloat16' s/y
                                        # history storage

    # --- engine knobs ---
    base_diameter: int = 256            # level-0 shortest side
    compute_dtype: str = "float32"      # 'float32' | 'bfloat16' conv compute
    conv_precision: str = "default"     # 'default' | 'high': TF32 allowed
                                        # for cuDNN convs; 'highest': full
                                        # float32 (see precision_gate;
                                        # matmuls are always float32)
    stream_every: int = 10              # steps per progress yield
    pipeline_streaming: bool = True     # lookahead (Adam): chunk k's
                                        # progress image is copied and
                                        # yielded while chunk k+1 runs
                                        # (same values)
    seed: int = 0

    # --- demonstration / ablation flags ---
    demo_normal_noise: bool = False
    demo_no_gaussian_mask: bool = False
    demo_ignore_gradient_map: bool = False
    dump_masks_dir: str = ""
    use_pallas: bool = False            # kept for parity; on the card the
                                        # Gram and TV always run through the
                                        # hand-written kernels
    pool_impl: str = "reduce_window"    # XLA pool lowering; the port has
                                        # one max-pool (same semantics)
    fused_style_bwd: bool = True        # closed-form style-layer backward
    nan_checks: bool = True             # raise on a non-finite loss at
                                        # synced chunk boundaries
    remat_levels: bool = False          # recompute each pyramid level's
                                        # activations in the backward
                                        # (torch.utils.checkpoint)
    stop_tol: float = 0.0               # convergence early-stop on the
                                        # relative loss change per chunk
    stop_shrink: bool = True            # batched runs: converged jobs
                                        # leave the batch


NO_NOISE_CONFIG = Config(
    noise_factor=0.0,
    noise_levels=(),
    noise_levels_central_amplitude=(),
    noise_levels_peripheral_amplitude=(),
    noise_levels_dispersion=(),
)

PIXEL_WIDE_NOISE_CONFIG = Config(
    noise_factor=0.5,
    noise_levels=(-1,),
    noise_levels_central_amplitude=(1.0,),
    noise_levels_peripheral_amplitude=(1.0,),
    noise_levels_dispersion=(0.5,),
)

NOISE_128_CONFIG = Config(
    noise_factor=0.7,
    noise_levels=(128,),
    noise_levels_central_amplitude=(1.0,),
    noise_levels_peripheral_amplitude=(1.0,),
    noise_levels_dispersion=(0.5,),
)

NOISE_16_CONFIG = Config(
    noise_factor=0.7,
    noise_levels=(16,),
    noise_levels_central_amplitude=(1.0,),
    noise_levels_peripheral_amplitude=(1.0,),
    noise_levels_dispersion=(0.5,),
)

STANDARD_GAUSS_NOISE_CONFIG = Config()

LIGHT_GAUSS_NOISE_CONFIG = Config(
    content_weight=1e3,
    style_weight=1e3,
    tv_weight=0e0,
    levels_num=2,
    iters_num=1500,
    noise_factor=0.95,
    noise_levels=(32, 64, 128, -1, 0),
    noise_levels_central_amplitude=(0.10, 0.15, 0.5, 0.10, 0.00),
    noise_levels_peripheral_amplitude=(0.20, 0.30, 0.10, 0.80, 0.00),
)

STARTING_CONFIG = Config(levels_num=1, iters_num=10)

PRESETS = {
    "no_noise": NO_NOISE_CONFIG,
    "pixel_wide": PIXEL_WIDE_NOISE_CONFIG,
    "noise_128": NOISE_128_CONFIG,
    "noise_16": NOISE_16_CONFIG,
    "standard": STANDARD_GAUSS_NOISE_CONFIG,
    "light_gauss": LIGHT_GAUSS_NOISE_CONFIG,
    "smoke": STARTING_CONFIG,
}


def reference_equivalent_steps(config: Config, reference_iters: int) -> int:
    """Map the reference's iters_num (closure evaluations) onto optimizer
    steps: one reference-semantics L-BFGS step (max_ls=0) spends two
    evaluations, Adam one."""
    if config.optimizer == "lbfgs":
        if config.lbfgs_max_ls_steps == 0:
            return max(1, reference_iters // 2)
        raise ValueError(
            "the reference's closure-count iteration unit has no fixed "
            "optimizer-step equivalence under a real line search "
            "(1 + n_evals closure calls per step, data-dependent)")
    return reference_iters


def production_config(base: Config | None = None, device=None) -> Config:
    """The deployment default on CUDA (device None: CUDA when a card is
    visible); on the CPU the config unchanged.

    The JAX package flips four settings on a TPU. Decided on the card
    (NVIDIA H100 80GB HBM3, 700.00 W; scripts/profile_torch_step.py
    --t-init unit and chip_smoke.py's lbfgs_state phase, PERF.md §6 PR 8):
    - carried L-BFGS Grams (lbfgs_grams='incremental', matrix direction):
      applied. The 8-lane step's device busy time fell 66.6 -> 33.5 ms:
      the recompute's two bmm took 36.2 ms of cuBLAS per step, the
      refresh's GEMVs 3.2. An explicit --lbfgs-grams recompute opts out.
    - bfloat16 history: not applied. Its final loss was within 0.01% of
      float32 history, but its step was not faster: at 8 lanes 33.2
      against 32.7 ms of device time per evaluation and 42.0-42.3 against
      38.7-40.0 ms of wall, at one lane 20.1-23.2 against 16.5-17.3 ms.
    - bfloat16 compute and the unit line-search opening: not measured
      here, not applied.
    """
    cfg = base if base is not None else Config()
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type != "cuda":
        return cfg
    if (cfg.optimizer == "lbfgs" and cfg.lbfgs_direction == "matrix"
            and cfg.lbfgs_grams == "recompute"):
        cfg = dataclasses.replace(cfg, lbfgs_grams="incremental")
    return cfg


# conv_precision -> (cudnn.allow_tf32, cudnn.deterministic) while a job of
# it holds the gate; None leaves that switch as it was
_CUDNN = {"default": (True, None), "high": (True, None),
          "highest": (False, True)}


class _PrecisionGate:
    """Who runs device work, and with which cuDNN settings.

    torch.backends.cudnn.allow_tf32 and torch.backends.cudnn.deterministic
    are switches for the whole process, and the executor runs jobs in
    several threads at once. A job holds the gate around each unit of
    device work (never across a yield), and while it is held the switches
    have the holder's values: jobs of the same conv_precision hold it
    together, a job of another one waits until no job holds it. Waiting
    jobs enter in their order of arrival, so none starves. A thread that
    holds the gate enters it again at once (its own precision) or raises
    (another one): it never waits while it holds it, so the executor's
    thread pool cannot deadlock. The switches get back their values from
    before when the last holder leaves.

    'highest' also turns on cuDNN's deterministic algorithms: its default
    float32 ones sum in an order that varies from run to run, and two runs
    of one job parted on the card (PERF.md §6). TF32 jobs keep the switch
    as it was.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._precision = None  # of the holders; None while nobody holds
        self._depth: Dict[int, int] = {}  # holding thread -> nesting depth
        self._queue: Deque[object] = collections.deque()  # waiters, FIFO
        self._saved = (False, False)  # the switches from before

    @contextlib.contextmanager
    def hold(self, precision: str):
        if precision not in _CUDNN:
            raise ValueError(f"unknown conv_precision {precision!r}")
        me = threading.get_ident()
        with self._cond:
            if me in self._depth:
                if precision != self._precision:
                    raise RuntimeError(
                        f"a {precision!r} job inside a {self._precision!r} "
                        "job on one thread")
            else:
                ticket = object()
                self._queue.append(ticket)
                try:
                    while not (self._queue[0] is ticket
                               and self._precision in (None, precision)):
                        self._cond.wait()
                finally:
                    self._queue.remove(ticket)
                    self._cond.notify_all()  # the next in line may enter too
                if self._precision is None:
                    self._precision = precision
                    cudnn = torch.backends.cudnn
                    self._saved = (cudnn.allow_tf32, cudnn.deterministic)
                    cudnn.allow_tf32, cudnn.deterministic = (
                        old if new is None else new
                        for old, new in zip(self._saved, _CUDNN[precision]))
            self._depth[me] = self._depth.get(me, 0) + 1
        try:
            yield
        finally:
            self._leave(me)

    def _leave(self, me: int) -> None:
        with self._cond:
            self._depth[me] -= 1
            if not self._depth[me]:
                del self._depth[me]
            if not self._depth:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cudnn.deterministic) = self._saved
                self._precision = None
                self._cond.notify_all()

    @contextlib.contextmanager
    def join(self, precision: str):
        """Hold the gate from a helper thread of a holder (a mesh's shard
        thread): it enters at once, without waiting behind other arrivals,
        because its holder keeps the gate at `precision` until the helper
        is done. Raises unless the gate is held at that precision."""
        me = threading.get_ident()
        with self._cond:
            if not self._depth or self._precision != precision:
                raise RuntimeError(
                    f"joining a {precision!r} precision gate that is not "
                    "held at it")
            self._depth[me] = self._depth.get(me, 0) + 1
        try:
            yield
        finally:
            self._leave(me)

    def held(self):
        """The precision the calling thread holds the gate at, or None."""
        with self._cond:
            if threading.get_ident() in self._depth:
                return self._precision
            return None


_GATE = _PrecisionGate()


def precision_gate(precision: str):
    """Context manager around one unit of a job's device work: cuDNN's
    convolutions run in TF32 for 'default' and 'high' and in full float32
    for 'highest', which also runs cuDNN's deterministic algorithms (see
    _PrecisionGate). Matmuls always run in full float32: the port never
    sets torch.backends.cuda.matmul.allow_tf32. Raises ValueError for an
    unknown precision."""
    return _GATE.hold(precision)


def join_precision_gate(precision: str):
    """Context manager: a helper thread of a holder of precision_gate at
    `precision` holds it too, without waiting (see _PrecisionGate.join)."""
    return _GATE.join(precision)


def held_precision():
    """The conv_precision the calling thread holds precision_gate at, or
    None outside the gate."""
    return _GATE.held()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names the
    CPU. Raises when CUDA is asked for (explicitly or by default) and no
    card is visible — the port never falls back to the CPU quietly — and
    for a card index that is not visible. A CUDA device comes back with
    its index ('cuda' names the calling thread's current card), so work
    handed to another thread stays on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"{dev} is not visible "
                             f"({torch.cuda.device_count()} card(s))")
    return dev
