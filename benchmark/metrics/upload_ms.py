"""upload_ms: the windows' upload to the device (the program's spans
``window.upload``: ``DeviceWindow.from_window`` and the placement's shard),
summed over a job's windows, mean over the window's jobs, in
milliseconds."""

from benchmark import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "window.upload")
