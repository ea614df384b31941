"""CUDA kernels per encrypted predict (the SMPC protocol: sharing, the
dealer's draws, Beaver rounds, truncation, reconstruction): kernels that
started inside the traced predicts' spans over their count."""

LAYER = "SMPC protocol"
UNIT = "launches/predict"
MOVES = "predict_ms_p95"


def read(ctx):
    t = ctx["trace"]
    if t is None or not t.span_count("predict"):
        return None
    kernels = [op for op in t.ops_in_span("predict")
               if not op[0].startswith(("Memcpy", "Memset"))]
    return len(kernels) / t.span_count("predict") if kernels else None
