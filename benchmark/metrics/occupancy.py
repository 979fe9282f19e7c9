"""`occupancy` (and `occupancy.<cells>`): segments over windows x window
levels x lanes (render_regen's stats["occupancy"]), summed over the
window's images, in %."""


def read(run):
    units = [u for u in run.units if u.get("occupancy")]
    if not units:
        return None
    slots = sum(u["segments"] / u["occupancy"] for u in units)
    return 100.0 * sum(u["segments"] for u in units) / slots
