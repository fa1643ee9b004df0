"""Cost analysis of the port: the dry run's wire model, counters and
roofline."""
