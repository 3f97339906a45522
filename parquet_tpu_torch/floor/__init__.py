"""Time of day with nanoseconds (floor.Time), for TIME filter values."""
