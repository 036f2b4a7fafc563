"""grid_build_s: the benchmark's clock around ``load_mesh`` (host grid,
device upload of nothing yet: the DeviceGrid is built on first use)."""


def read(run):
    return run.grid_build_s
