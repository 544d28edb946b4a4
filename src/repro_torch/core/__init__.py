"""Core library: topology learning, theory and dynamic schedules (numpy
copies) and D-SGD mixing (torch)."""

from . import (
    assignment,
    dcliques,
    dsgd,
    dynamic,
    heterogeneity,
    mixing,
    stl_fw,
    theory,
    topology,
)
from .dsgd import DSGDState, dsgd_init, dsgd_step_stacked
from .mixing import (
    BirkhoffSchedule,
    PermPool,
    PoolSwap,
    ScheduleArrays,
    mix_dense,
    mix_schedule_arrays,
    mix_schedule_stacked,
    mix_stacked,
    schedule_from_matrix,
    schedule_from_result,
    schedule_to_arrays,
    truncate_schedule,
)
from .stl_fw import STLFWResult, fw_upper_bound, learn_topology, stl_fw_objective

__all__ = [
    "assignment",
    "dcliques",
    "dsgd",
    "dynamic",
    "heterogeneity",
    "mixing",
    "stl_fw",
    "theory",
    "topology",
    "DSGDState",
    "dsgd_init",
    "dsgd_step_stacked",
    "BirkhoffSchedule",
    "PermPool",
    "PoolSwap",
    "ScheduleArrays",
    "mix_dense",
    "mix_schedule_arrays",
    "mix_schedule_stacked",
    "mix_stacked",
    "schedule_from_matrix",
    "schedule_from_result",
    "schedule_to_arrays",
    "truncate_schedule",
    "STLFWResult",
    "fw_upper_bound",
    "learn_topology",
    "stl_fw_objective",
]
