"""The training runtime: step retries, straggler detection, the checkpointed loop,
and resharding a (restored) state onto another mesh (:mod:`.elastic`)."""

from .elastic import reshard_state, state_shardings, state_specs
from .fault_tolerance import StragglerDetector, TrainLoop, run_with_retries

__all__ = ["StragglerDetector", "TrainLoop", "reshard_state", "run_with_retries",
           "state_shardings", "state_specs"]
