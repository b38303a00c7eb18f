"""Observability for the port: the span tracer the store reports into."""

from .tracer import Span, Tracer, get_tracer, set_tracer, span, start

__all__ = ["Span", "Tracer", "get_tracer", "set_tracer", "span", "start"]
