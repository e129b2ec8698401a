"""fiber — task runtime: the bthread equivalent (SURVEY §2.2)."""

from brpc_tpu_torch.fiber.butex import Butex
from brpc_tpu_torch.fiber.runtime import (
    TaskControl,
    FiberTask,
    global_control,
    start_background,
    start_urgent,
    DEFAULT_TAG,
)
from brpc_tpu_torch.fiber.timer import TimerThread, global_timer, timer_add, timer_del
from brpc_tpu_torch.fiber.execution_queue import ExecutionQueue
from brpc_tpu_torch.fiber.call_id import (
    IdGone,
    id_create,
    id_lock,
    id_lock_verify,
    id_unlock,
    id_unlock_and_destroy,
    id_join,
    id_error,
    id_version,
    id_bump_version,
    id_about_to_destroy,
)

__all__ = [
    "Butex",
    "TaskControl",
    "FiberTask",
    "global_control",
    "start_background",
    "start_urgent",
    "DEFAULT_TAG",
    "TimerThread",
    "global_timer",
    "timer_add",
    "timer_del",
    "ExecutionQueue",
    "IdGone",
    "id_create",
    "id_lock",
    "id_lock_verify",
    "id_unlock",
    "id_unlock_and_destroy",
    "id_join",
    "id_error",
    "id_version",
    "id_bump_version",
    "id_about_to_destroy",
]
