"""The protocol core of the port: trust scoring, aggregation, the round
(``fl_step``), and the chain node that drives and settles it."""
