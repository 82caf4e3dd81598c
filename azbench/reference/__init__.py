"""The plain reference the benchmark's checks hold the program to: the
games' rules, the networks in float32 and the PUCT search.  It imports
nothing of the program."""
