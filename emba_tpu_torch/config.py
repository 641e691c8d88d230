"""Configuration: the run's dataclass and the per-sequence presets
(counterpart of ``emba_tpu/config.py``).

The fields, defaults and presets are those of the reference module, so
``params.txt`` and a preset read the same in both packages, with two
exceptions that the reference set from measurements on its own hardware:
``fused_event_cap`` has no default fence here, and the classic-window event
limits live in ``pipeline.py`` with the measurement they came from.
"""

from __future__ import annotations

import dataclasses

from .model import ModelConfig
from .solver import LMConfig


@dataclasses.dataclass
class BAConfig:
    """Full run configuration (reference ``BASettings`` + dataset info)."""

    dataset: str = "ECRot_dataset"
    sequence: str = "synth"
    # Time interval for BA [s] (sequence-relative; time_offset applied on load)
    start_time: float = 0.1
    stop_time: float = 2.4
    time_offset: float = 0.0

    # Measurement model
    c_th: float = 0.2
    thres_valid_pixel: int = 5
    alpha: float = 5.0
    damping_factor: float = 1.0
    outlier_dp_norm: float = 10.0
    # Map sampling point of the LEGM residual: "curr" (the reference
    # formulation) or "mid" (midpoint-rule quadrature).
    sample_mode: str = "curr"
    # Coarse-to-fine: each window's pose pre-solved at a half-resolution
    # panorama. Multi-start: each window solved with the four (sample_mode
    # x coarse_to_fine) variants, the one of lowest data cost kept.
    coarse_to_fine: bool = False
    multi_start: bool = False

    # Solver options
    use_cg: bool = False
    use_irls: bool = False
    cost_type: str = "quadratic"
    eta: float = 0.1

    # Events
    event_batch_size: int = 100
    event_sampling_rate: int = 1

    # Map
    init_map_available: bool = True
    pano_height: int = 512
    pano_width: int = 1024

    # Trajectory
    dt_knots: float = 0.05
    spline_order: int = 2

    # Sliding window
    time_window_size: float | None = None  # None => whole BA span (as in exps)
    sliding_window_stride: float = 1.0

    # LM
    max_num_iter: int = 50
    tol_fun: float = 1e-3
    num_times_tol_fun_sat: int = 2

    # Numerics
    dtype: str = "float32"
    # Kept so that presets and params.txt match the reference; ignored: the
    # producer of the normal equations follows the device (model.py).
    use_pallas: bool | None = None
    # Run each window's LM on the device (solver.solve_window_fused: CUDA
    # graphs on the card): per-iteration logs and phase timings are then
    # unavailable. None = fused unless the run records data.
    fused_lm: bool | None = None
    # Largest event count a fused window may take; beyond it the pipeline
    # runs the host-driven loop and records it (runtime.json lm_mode). None
    # = no fence: no fused-window failure at any size has been seen on the
    # card.
    fused_event_cap: int | None = None
    # Active-pixel compaction cap (None: the pipeline picks one for
    # panoramas of 2M pixels or more and retunes it between windows).
    compact_cap: int | None = None
    # Streamed forming chunk (events): the linearization recomputed chunk by
    # chunk inside the objective and forming passes instead of held for the
    # whole window. None = chosen by the pipeline (2^21 above the
    # classic-window cap); 0 disables.
    stream_chunk: int | None = None
    # Streaming tier: False/None = FULL (no event-sized array survives a
    # pass; the default), True = LIGHT (the (N,) residual fields resident,
    # only the Jacobians recomputed).
    stream_light: bool | None = None
    # Light-trial LM (cost-only trials, Jacobians recomputed on accept).
    light_trial: bool | None = None
    # Mid-window LM checkpointing (recording runs, host-driven loops): the
    # full LM resume state into checkpoint.npz every N iterations, so an
    # interrupted window resumes bit for bit with --resume. 0 disables.
    # Fused windows checkpoint at window boundaries only.
    lm_checkpoint_every: int = 10
    # Ranks of a sharded window (dist.py; the process group must exist,
    # as cli run --num-devices spawns it). None = one device.
    num_devices: int | None = None
    # Super-resolution map: after a recording run, the full pixel grid at
    # this panorama height (width 2x) solved by the closed-form map-only
    # step from the refined trajectory, with no A12 and no compaction
    # (final_results/Gx_sr.bin, Gy_sr.bin, G_hsv_sr.png, poisson_sr.png,
    # super_res.json). None disables.
    super_res_height: int | None = None

    def model_config(self) -> ModelConfig:
        return ModelConfig(
            c_th=self.c_th,
            pano_width=self.pano_width,
            pano_height=self.pano_height,
            thres_valid_pixel=self.thres_valid_pixel,
            alpha=self.alpha,
            outlier_dp_norm=self.outlier_dp_norm,
            sample_mode=self.sample_mode,
            use_irls=self.use_irls,
            cost_type=self.cost_type if self.use_irls else "quadratic",
            eta=self.eta if self.use_irls else 1.0,
            spline_order=self.spline_order,
            light_trial=bool(self.light_trial),
            compact_cap=self.compact_cap,
            stream_chunk=self.stream_chunk or None,
            stream_light=bool(self.stream_light) and bool(self.stream_chunk),
        )

    def lm_config(self) -> LMConfig:
        return LMConfig(
            max_num_iter=self.max_num_iter,
            tol_fun=self.tol_fun,
            num_times_tol_fun_sat=self.num_times_tol_fun_sat,
        )

    @property
    def window_size(self) -> float:
        if self.time_window_size is None:
            return self.stop_time - self.start_time
        return self.time_window_size


# ECD (rpg_ijrr_dataset) event-vs-groundtruth time offsets
# (reference emba.cpp:227-241).
ECD_TIME_OFFSETS = {
    "shapes_rotation": 1468939802.884364206,
    "poster_rotation": 1468940145.246817987,
    "boxes_rotation": 1468940843.845407417,
    "dynamic_rotation": 1473347265.928210508,
}

# Common values across all ten launch files: C_th per sequence; BA interval;
# everything else shared (max_num_iter=50, tol_fun=1e-3, thres_valid_pixel=5,
# alpha=5.0, damping=1.0, dt_knots=0.05, quadratic cost, no CG/IRLS).
_COMMON = dict(
    thres_valid_pixel=5,
    alpha=5.0,
    damping_factor=1.0,
    dt_knots=0.05,
    max_num_iter=50,
    tol_fun=1e-3,
    num_times_tol_fun_sat=2,
    use_cg=False,
    use_irls=False,
    event_batch_size=100,
    event_sampling_rate=1,
    sliding_window_stride=1.0,
)

# (dataset, start, stop, C_th) per sequence, from launch/*.launch.
_SEQUENCES = {
    # ECRot synthetic/real
    "playroom": ("ECRot_dataset", 0.1, 2.4, 0.45),
    "bicycle": ("ECRot_dataset", 0.1, 4.9, 0.2),
    "city": ("ECRot_dataset", 0.1, 4.9, 0.2),
    "street": ("ECRot_dataset", 0.1, 4.9, 0.2),
    "town": ("ECRot_dataset", 0.1, 4.9, 0.2),
    "bay": ("ECRot_dataset", 0.1, 4.9, 0.2),
    # ECD rotation sequences (BA interval 1.0-11.0, launch/{shapes,...}.launch)
    "shapes_rotation": ("rpg_ijrr_dataset", 1.0, 11.0, 0.2),
    "poster_rotation": ("rpg_ijrr_dataset", 1.0, 11.0, 0.2),
    "boxes_rotation": ("rpg_ijrr_dataset", 1.0, 11.0, 0.2),
    "dynamic_rotation": ("rpg_ijrr_dataset", 1.0, 11.0, 0.2),
}


def preset(sequence: str, **overrides) -> BAConfig:
    """Per-sequence configuration mirroring ``launch/<sequence>.launch``."""
    if sequence not in _SEQUENCES:
        raise KeyError(
            f"unknown sequence {sequence!r}; available: {sorted(_SEQUENCES)}"
        )
    dataset, start, stop, c_th = _SEQUENCES[sequence]
    cfg = BAConfig(
        dataset=dataset,
        sequence=sequence,
        start_time=start,
        stop_time=stop,
        c_th=c_th,
        time_offset=ECD_TIME_OFFSETS.get(sequence, 0.0),
        **_COMMON,
    )
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg
