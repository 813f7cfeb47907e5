"""The trainer's resilience: the preemption grace path
(``--preempt-grace``, preemption.py) and deterministic fault drills
(``--inject-fault``, faults.py).  ``tools/supervise.py`` restarts
``python -m apex_example_tpu_torch.train`` on the exit codes they
produce."""

from apex_example_tpu_torch.resilience.faults import (KINDS, FaultInjected,
                                                      FaultPlan)
from apex_example_tpu_torch.resilience.preemption import (EX_TEMPFAIL,
                                                          PreemptionHandler)

__all__ = ["EX_TEMPFAIL", "FaultInjected", "FaultPlan", "KINDS",
           "PreemptionHandler"]
