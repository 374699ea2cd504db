"""Offline tuning campaigns: plan -> schedule -> run -> export.

The port of ``repro.campaign``: turn the tuning core's primitives into the
shippable artifact, a per-platform tuning database.

  plan      the concrete tuning jobs (kernel x shape bucket x dtype) a
            deployment hits: the training step's dispatch sites on one
            card or one data-parallel rank, forward and backward, and the
            serving engine's slot-pool buckets          -> campaign.planner
  schedule  dedup jobs by database key, rank them by the roofline seconds
            at stake on this card, split a global evaluation budget, keep a
            resumable manifest                          -> campaign.scheduler
  run       tune jobs best-first on the card, each search warm-started from
            the nearest record                          -> campaign.runner
  export    cluster winners into cover sets and write the database for one
            platform                                    -> campaign.runner

CLI: ``python -m repro_torch.campaign {plan,run,status,export}``.
"""
from .planner import (  # noqa: F401
    DEFAULT_KERNELS,
    TuningJob,
    plan_jobs,
    plan_serving_jobs,
    plan_train_jobs,
    plan_training_jobs,
    serving_buckets,
)
from .runner import (  # noqa: F401
    export_campaign_db,
    materialize_args,
    run_campaign,
    summarize_telemetry,
)
from .scheduler import (  # noqa: F401
    CampaignManifest,
    allocate_budget,
    build_manifest,
    dedupe_jobs,
    prioritize_jobs,
)
from .transfer import cluster_winners, compute_covers, warm_start_configs  # noqa: F401
