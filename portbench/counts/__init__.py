"""The work of each kernel the benchmark reads a roofline share of, and
the card's published peaks: the yardstick of every `*_roofline_share`
metric, kept with the benchmark and not with the program."""
