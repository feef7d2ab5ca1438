"""Engine of the PyTorch port: the single-patch DIP solver, its histories
and the Langevin optimizers."""
from .history import History, HistoryPOCS, HistoryReg
from .optimizers import PSGLD, SGLD, psgld, sgld
from .solver import (DIPSolver, SolveResult, StepSettings, build_base_input,
                     build_data, build_hyper, pad_multiple_for, padded_spatial)

__all__ = ["DIPSolver", "SolveResult", "StepSettings", "History",
           "HistoryPOCS", "HistoryReg", "build_base_input", "build_data",
           "build_hyper", "pad_multiple_for", "padded_spatial", "PSGLD", "SGLD", "psgld",
           "sgld"]
