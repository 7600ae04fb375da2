"""The port's serving paths: ``/generate`` (``paged.PagedDecoder``,
``mesh.MeshPagedDecoder``) and ``/predict`` (``batcher.DynamicBatcher``
over ``registry.ModelRegistry``), both behind ``engine.ServingEngine``;
the fleet of engines behind ``router.FleetRouter`` (``fleet``,
``autoscale``, ``placement``)."""
