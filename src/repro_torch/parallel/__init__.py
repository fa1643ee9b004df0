"""Gradient collectives over emulated pods: buckets, schedules, chains."""
