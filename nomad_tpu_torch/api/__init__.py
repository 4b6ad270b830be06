"""HTTP API: server routes + typed client (ref command/agent/http.go, api/)."""

from .client import APIError, ApiClient
from .http import HTTPServer
