"""Traffic of the benchmark: the frozen frame generator (`ring`), its scene
data, and one parameter file per mix (`<traffic>.json`)."""
