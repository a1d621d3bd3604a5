"""Tools of the port: the bench-checkpoint training recipe and probes that
measure on the card."""
