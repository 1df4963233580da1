"""The server's host work a round (dedup, detokenisation, physicochemical
columns, row dicts): its ``host_postproc`` stage seconds over the window's
rounds, in ms, on the host clock."""


def read(ctx):
    rounds = ctx["after"]["rounds"] - ctx["before"]["rounds"]
    st1 = ctx["after"].get("stage_s", {})
    st0 = ctx["before"].get("stage_s", {})
    if rounds <= 0 or "host_postproc" not in st1:
        return None
    return 1e3 * (st1["host_postproc"] - st0.get("host_postproc", 0.0)) / rounds
