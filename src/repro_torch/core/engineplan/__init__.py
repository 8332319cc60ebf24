"""Plan -> step core -> chunk pipeline, as in ``repro.core.engineplan``
(one device, no mesh)."""
