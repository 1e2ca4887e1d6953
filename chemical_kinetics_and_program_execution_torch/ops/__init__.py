"""Observable projections of the port."""
