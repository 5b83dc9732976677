"""TFETI assembly and the large-path solve."""
