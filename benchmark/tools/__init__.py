"""Tools that set the benchmark's limits; the runs themselves do not
use them."""
