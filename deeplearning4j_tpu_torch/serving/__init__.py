"""The port's ``/generate`` serving path: ``paged.PagedDecoder`` behind
``engine.ServingEngine``."""
