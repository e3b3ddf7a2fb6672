"""Special functions, inverse CDFs, random bits and the open-interval clamp."""
