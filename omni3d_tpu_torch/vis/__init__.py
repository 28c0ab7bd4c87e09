"""AP result tables."""
