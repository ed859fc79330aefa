"""host_call_ms.stream: the host's time inside ``match_batch`` per frame
(the pageable upload and the enqueue of every launch), the benchmark's
own span around the call summed over the untraced window over its
frames, so that the profiler's cost on the host is not in it.  Host-fed
cells only."""


def read(record):
    if record.traffic["feed"] != "host" or not record.host_call_s:
        return None
    return sum(record.host_call_s) * 1e3 / record.frames
