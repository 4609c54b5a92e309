"""Inputs made from the seed: the vector sets (``data``) and the arrivals
of the traffic mixes (``arrivals``, ``openloop``)."""
