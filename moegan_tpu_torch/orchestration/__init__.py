from moegan_tpu_torch.orchestration.flags import FlagStore
from moegan_tpu_torch.orchestration.jobs import JobRunner, JobSpec
from moegan_tpu_torch.orchestration.pipeline import STAGES, Pipeline

__all__ = ["FlagStore", "JobRunner", "JobSpec", "Pipeline", "STAGES"]
