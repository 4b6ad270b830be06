"""Client agent: fingerprint, alloc/task runners, drivers (ref client/)."""

from .client import AllocRunner, Client, TaskRunner
from .driver import BUILTIN_DRIVERS, Driver, MockDriver, RawExecDriver, TaskHandle
