from repro_torch.serving.engine import (  # noqa: F401
    ServeEngine,
    audit_decode,
    serve_step,
    token_agreement,
)
