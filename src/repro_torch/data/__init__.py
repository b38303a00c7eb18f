"""Deterministic, resumable token pipelines (``pipeline``)."""
