"""GYM planning (GHDs, DYM schedules) and execution (physical layer, driver)."""
