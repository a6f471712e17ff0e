"""The plain reference the benchmark's check compares against: frozen
copies of the port's plain math, importing nothing of the port."""
