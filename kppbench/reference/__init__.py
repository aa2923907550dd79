"""The benchmark's plain reference: frozen copies of the port's plain step and
initial-state derivation (commit a49d027), importing nothing of the program."""
