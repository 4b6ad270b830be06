"""Command-line interface (ref command/)."""

from .main import main
