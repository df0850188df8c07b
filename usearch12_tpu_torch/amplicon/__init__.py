"""Amplicon commands of the port whose device path runs on the card."""
