"""The median of the bot cell's ``/api/move`` round trips in the window,
on the host's clock."""


def read(run):
    if run.driver.kind != "bot":
        return None
    return run.driver.window_stats["p50"]
