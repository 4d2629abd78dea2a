"""Batched multi-job execution: the job queue in lanes, on one card or
over a mesh of cards (jobs over its jobs axis, one job's pixels over its
space axis)."""

from .mesh import (Mesh, default_serving_mesh, jobs_mesh,  # noqa: F401
                   jobs_space_mesh, multislice_jobs_space_mesh)
from .batch import (BatchedTransferJob, bucket_jobs,  # noqa: F401
                    max_jobs_per_batch, resolve_batch_policy, run_job_queue)
