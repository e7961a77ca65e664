"""Launchers and analysis tools of the port (``repro``'s ``launch/``): the
training launcher (``train``), the collective accounting of a distributed
step (``comm_analysis``) and the roofline pricing of dry-run records
against the H100 (``roofline``)."""
