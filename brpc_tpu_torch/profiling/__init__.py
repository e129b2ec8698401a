"""brpc_tpu_torch.profiling — whole-process statistical profiler.

- registry: thread-role registry + per-thread span-phase markers (import
  this directly from hot paths; it has no dependencies)
- sampler: sys._current_frames() folded-stack sampler (one-shot,
  start/stop session, always-on continuous ring)
- diff: folded-profile differ (top self-time movers)
"""

from brpc_tpu_torch.profiling.registry import (  # noqa: F401
    ROLE_BATCH, ROLE_HEALER, ROLE_POLLER, ROLE_SAMPLER, ROLE_TIMER,
    ROLE_USER, ROLE_WORKER, phase, phase_of, register_current_thread,
    role_of, set_phase, threads_by_role, unregister_current_thread)
from brpc_tpu_torch.profiling.sampler import (  # noqa: F401
    ContinuousProfiler, FoldedProfile, ProfileSession, collapse,
    continuous, ensure_continuous_started, run_profile)
