"""The cascade and the detector of the score path."""
