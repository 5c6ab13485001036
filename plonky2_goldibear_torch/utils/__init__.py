"""Host utilities of the circuit builder."""
