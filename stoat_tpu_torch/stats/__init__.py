"""Statistics of the port (float64): chi-squared, Fisher exact, tails."""
