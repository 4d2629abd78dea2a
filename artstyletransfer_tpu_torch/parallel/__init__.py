"""Batched multi-job execution: the job queue in lanes on one card."""

from .batch import (BatchedTransferJob, bucket_jobs,  # noqa: F401
                    max_jobs_per_batch, resolve_batch_policy, run_job_queue)
