"""upload_gbps.stream: the bytes the engine uploaded in the traced window
(``SGMEngine.upload_bytes``) over the device seconds of the host-to-device
copies launched inside the program's ``sgm.upload`` spans (found by the
profiler's correlation ids), in GB/s.  Host-fed cells only."""

UPLOAD = "sgm.upload"
COPY = "Memcpy HtoD"


def read(record):
    t = record.traced
    if record.traffic["feed"] != "host" or t is None:
        return None
    seconds = sum(s for name, s in t.span_device_s.get(UPLOAD, {}).items()
                  if name.startswith(COPY))
    if not seconds or not t.upload_bytes:
        return None
    return t.upload_bytes / seconds / 1e9
