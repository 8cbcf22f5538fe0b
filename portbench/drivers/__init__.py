"""One driver per entry the traffic mixes name (a mix's ``driver``)."""
