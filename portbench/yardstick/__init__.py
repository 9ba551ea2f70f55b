"""The benchmark's yardstick: traffic, costs, trace arithmetic, tails."""
