"""Operation and byte counts, one file per model kind or kernel, and the
card's published peaks (``peaks.py``).  They read sizes only: the
configuration, the cell's traffic, and counts the program reports."""
