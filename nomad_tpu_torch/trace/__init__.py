"""End-to-end trace plane: per-eval span trees from submit to device and
back, with critical-path attribution (see OBSERVABILITY.md).

- :mod:`.span` — SpanContext/Span, the process :data:`tracer`
  (propagation registries, eval lifecycle, metric-unified spans);
- :mod:`.store` — bounded ring store with slowest-N + error tail keeps;
- :mod:`.critical_path` — per-stage attribution of ``eval.e2e`` from
  retained traces (the `/v1/trace/critical-path` + CLI surface).
"""

from .critical_path import (  # noqa: F401
    attribute,
    attribute_trace,
    build_tree,
    format_report,
    orphan_count,
)
from .span import NOOP_SPAN, Span, SpanContext, Tracer, tracer  # noqa: F401
from .store import TraceStore  # noqa: F401
