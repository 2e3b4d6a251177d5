"""The pipeline — stage sequencing, resume, fault injection (counterpart of
cloudvectordb_tpu/pipeline)."""

from cloudvectordb_tpu_torch.pipeline.run import FailInjection, Pipeline, run_pipeline  # noqa: F401
