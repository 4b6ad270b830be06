"""Job specification parser: HCL → Job (ref jobspec/)."""

from .hcl import HCLError, parse as parse_hcl, parse_duration
from .parse import parse_job
