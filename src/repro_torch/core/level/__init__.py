"""The level data plane: split engines + the per-level plan."""
from repro_torch.core.level.engines import (CategoricalTable, ExactNumeric,
                                            LegacyFn, LevelInputs,
                                            LevelStatics, SplitEngine)
from repro_torch.core.level.plan import LevelPlan, make_plan

__all__ = ["CategoricalTable", "ExactNumeric", "LegacyFn", "LevelInputs",
           "LevelPlan", "LevelStatics", "SplitEngine", "make_plan"]
