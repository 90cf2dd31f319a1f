"""Analytic cost model (``roofline``) at one H100's peaks, and the dry
run's report (``report``)."""
