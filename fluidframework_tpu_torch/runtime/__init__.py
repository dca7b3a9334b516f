"""Runtime side: the summary generation store (the recovery ladder)."""
