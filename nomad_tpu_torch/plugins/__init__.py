"""Plugin framework: drivers (and device plugins) as isolated subprocesses.

The reference runs external plugins as subprocesses speaking gRPC over a
unix socket through go-plugin (plugins/base/proto/base.proto, drivers
service plugins/drivers/proto/driver.proto:13-84). Here the same boundary
is the repo's framed-msgpack RPC (rpc/codec.py) over a unix socket:
``serve`` hosts a Driver implementation inside the plugin process, and
``ExternalDriver`` is the client-side proxy that spawns it, speaks the
protocol, and exposes the ordinary in-process Driver interface — so the
client agent cannot tell a subprocess driver from a builtin one.
"""

from .external import ExternalDriver
from .serve import serve_driver

__all__ = ["ExternalDriver", "serve_driver"]
