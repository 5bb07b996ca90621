"""The training runtime: step retries, straggler detection, the checkpointed loop.

The JAX package's ``elastic`` (resharding a restored state onto another
device mesh) waits for the multi-card port.
"""

from .fault_tolerance import StragglerDetector, TrainLoop, run_with_retries

__all__ = ["StragglerDetector", "run_with_retries", "TrainLoop"]
