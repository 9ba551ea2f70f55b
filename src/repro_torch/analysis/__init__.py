"""Analysis for the port: the discrete-event simulator and the plan gate."""
