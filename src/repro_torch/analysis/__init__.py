"""Static analysis of a step: its counted work (``hlo``) and the roofline
over the dry-run's results (``roofline``)."""
