"""Traffic kinds: one generator and runner per kind, found by the name a traffic mix gives."""
