"""Device ms a request of the host<->card copies (the request batch in, the
result out) in the traced requests."""


def read(t):
    ms = sum(d for name, _, d in t.copies if "HtoD" in name or "DtoH" in name) * 1e-3
    return ms / t.requests if t.copies else None
