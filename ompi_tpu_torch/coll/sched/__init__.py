"""Schedule-compiler package (this slice ports only its priors)."""
