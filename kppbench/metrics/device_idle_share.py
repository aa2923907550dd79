"""device_idle_share: the share of the traced window (first host event to
last device event) in which no kernel, copy or set runs on the card, as
``tracing.stats`` computes it, in percent."""


def read(run):
    if not run.stats or not run.stats.get("device_events"):
        return None
    return 100.0 * run.stats["device_idle_share"]
