"""The port's serving paths: ``/generate`` (``paged.PagedDecoder``) and
``/predict`` (``batcher.DynamicBatcher`` over ``registry.ModelRegistry``),
both behind ``engine.ServingEngine``."""
