"""host_share: the share of the jobs' wall outside their windows' LM solves
(``LMStats.time_total_s``): the pipeline's event cut, pose fit, pairing,
upload and result handling on the host, in percent."""


def read(ctx):
    wall = sum(j["wall_s"] for j in ctx.jobs)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - sum(j["solve_s"] for j in ctx.jobs) / wall)
