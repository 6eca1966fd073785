"""The benchmark's own data: the UBA-profile KB generator and the univ-bench L program."""
