"""decode_mixer_share.serve (%): the device time of the token mixers
(attention over the cache with its K/V write, or the RWKV time mix; the
program's device spans ``decode.mixer``) over that of the whole decode
step (``decode.step``), over the steps the engine runs as the captured
body while the traced wave's profiler records, one at the head of each
batch's decode (``colonybench.program_trace``)."""

from colonybench import program_trace


def read(run: dict) -> float | None:
    return program_trace.device_share("decode.mixer", "decode.step")
