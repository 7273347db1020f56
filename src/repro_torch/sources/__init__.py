"""Pluggable arrival sources for the serving engine.

Port of ``repro/sources`` with three registered names: ``"trace"``
(:class:`TraceSource`, replay of pre-shaped arrivals), ``"synthetic"``
(:class:`SyntheticCameraSource`, live cameras running the edge pipeline;
``n_cameras > 1`` merges per-camera streams) and ``"file"``
(:class:`FileStreamSource`, a recording through the edge pipeline).
Construct by name through :func:`make_source`.
"""
from repro_torch.sources.base import (MergedSource, Source, SourceStats,
                                      make_source, register_source)
from repro_torch.sources.camera import (EdgePipeline, LiveSource,
                                        RateProfile, SyntheticCameraSource,
                                        synthetic_source)
from repro_torch.sources.filestream import FileStreamSource
from repro_torch.sources.trace import TraceSource

register_source("trace", TraceSource)
register_source("synthetic", synthetic_source)
register_source("file", FileStreamSource)

__all__ = [
    "EdgePipeline",
    "FileStreamSource",
    "LiveSource",
    "MergedSource",
    "RateProfile",
    "Source",
    "SourceStats",
    "SyntheticCameraSource",
    "TraceSource",
    "make_source",
    "register_source",
]
