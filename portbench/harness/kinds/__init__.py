"""One runner per traffic ``kind``: set-up, the measured window, the traced
slice and the check of what the timed path produced."""
