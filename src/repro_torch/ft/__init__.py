from repro_torch.ft.guard import all_finite, quarantine_distances, select_tree
from repro_torch.ft.inject import FaultSpec, fault_plan, parse_fault_args
from repro_torch.ft.restart import RestartStats, run_with_restarts

__all__ = ["all_finite", "quarantine_distances", "select_tree",
           "FaultSpec", "fault_plan", "parse_fault_args",
           "RestartStats", "run_with_restarts"]
